"""Device ops: K1 min-distance, voxel dedup, field lookups, small linear algebra."""

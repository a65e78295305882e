"""Synthetic scenes, software depth camera and camera helpers (host numpy)."""

"""Batched solvers: trajectory LM and box-constrained LM."""

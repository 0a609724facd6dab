"""Device resolution and JAX <-> port parameter mapping."""

"""Options (CLI DSL, yaml, device), console log, TensorBoard scalars, and
JAX<->torch parameter transfer."""

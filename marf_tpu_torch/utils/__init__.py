"""Options (CLI DSL, yaml, device), console log, TensorBoard scalars, the
tracer's spans and counters, and JAX<->torch parameter transfer."""

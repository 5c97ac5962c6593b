"""Train step and trainer."""

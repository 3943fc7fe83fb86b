"""Optimizer of the port: AdamW with the reference's decay mask, the
learning-rate schedule, and int8 gradient compression with error
feedback."""

"""The first-order linear recurrence ``c_t = a_t * c_{t-1} + b_t`` (B3)."""

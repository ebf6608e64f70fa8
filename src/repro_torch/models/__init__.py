"""Language-model blocks for block kind ``rnn``."""

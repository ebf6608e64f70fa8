"""Architecture configs (the port's own copies of ``repro.configs``)."""

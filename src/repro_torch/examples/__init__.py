"""The port's copies of the repo's examples (``examples/``), each run as
``python -m repro_torch.examples.<name>``, on the card unless ``--device
cpu`` is given: ``quickstart`` (train a tiny SRU LM and generate),
``train_lm`` (``launch.train`` on a llama-family model) and
``streaming_asr`` (the paper's single-stream SRU-1 against SRU-n)."""

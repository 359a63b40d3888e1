"""Training of the port: AdamW (``optimizer``), the train step with
microbatching and error-feedback compression (``train_step``,
``compress``), checkpoints in the JAX package's format (``checkpoint``)
and batch bookkeeping after a topology change (``elastic``)."""

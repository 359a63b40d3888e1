"""Training of the port: AdamW (``optimizer``), the train step with
microbatching and error-feedback compression (``train_step``,
``compress``, with the quantized all-reduce ``compressed_psum``),
checkpoints in the JAX package's format (``checkpoint``) and the elastic
re-mesh after a topology change (``elastic``: ``plan_mesh``, ``reshard``,
``scale_batch``)."""

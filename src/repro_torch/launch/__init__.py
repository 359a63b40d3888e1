"""Launchers of the port: the meshes (``mesh``: the host and production
meshes of the LM, the partition-shard mesh of the resident metadata
planes), the training driver (``train.main``), the abstract input specs
and shardings of every (arch x shape) (``specs``), the roofline with H100
terms (``roofline``) and the multi-pod dry-run (``dryrun``)."""

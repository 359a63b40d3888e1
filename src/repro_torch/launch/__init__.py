"""Launchers of the port: the partition-shard mesh of the resident
metadata planes (``mesh.make_plane_mesh``) and the training driver
(``train.main``)."""

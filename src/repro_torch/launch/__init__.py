"""Device meshes of the port: the partition-shard mesh of the resident
metadata planes (``mesh.make_plane_mesh``)."""

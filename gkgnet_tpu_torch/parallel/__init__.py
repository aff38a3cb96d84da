"""Data and graph parallelism on ``torch.distributed`` (counterpart:
``gkgnet_tpu/parallel/``): the mesh (``mesh.py``), the autograd-aware
collectives (``collectives.py``), the graph-sharding context
(``sharding.py``), the edge-partitioned graph builds
(``edge_partition.py``) and a spawner of worlds on one host
(``spawn.py``)."""

"""The distributed back end: shard meshes (``mesh``), the owner-sharded
window LBA (``dist_lba``), sharded BoW retrieval (``dist_vocab``) and the
two-process check (``multihost_check``)."""

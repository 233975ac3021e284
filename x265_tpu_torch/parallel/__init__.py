from .gop_sharding import encode_chains_sharded, make_gop_mesh  # noqa: F401

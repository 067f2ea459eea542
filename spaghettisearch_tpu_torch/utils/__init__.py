from .hashing import md5_hex  # noqa: F401

from .indexer import index_page  # noqa: F401
from .snapshot import IndexSnapshot, build_snapshot  # noqa: F401

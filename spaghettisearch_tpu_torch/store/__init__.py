from .docinfo import DocInfo  # noqa: F401
from .tables import Database, TABLE_SPECS  # noqa: F401

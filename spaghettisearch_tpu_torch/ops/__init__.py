from .weighting import update_term_weights  # noqa: F401
from .pagerank import pagerank_power, update_pagerank  # noqa: F401

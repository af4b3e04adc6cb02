from .polymul import (  # noqa: F401
    ALGORITHMS,
    intt,
    ntt,
    polymul_negacyclic,
    polymul_fixed_fn,
    polymul_fn,
    served_algo,
)

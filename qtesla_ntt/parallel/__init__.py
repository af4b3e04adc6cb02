from .mesh import make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    polymul_dp_fn,
    polymul_fixed_dp_fn,
    polymul_fourstep_sharded_fn,
    ntt_fourstep_sharded_fn,
    intt_fourstep_sharded_fn,
)
from .ulysses import (  # noqa: F401
    polymul_ulysses_fn,
    polymul_fixed_ulysses_fn,
    polymul_sp_fn,
)
from .distributed import (  # noqa: F401
    init_distributed,
    make_global_mesh,
    global_batch,
    local_shard,
)

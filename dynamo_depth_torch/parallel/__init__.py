"""Multi-process data parallelism (``parallel/dist.py``)."""

from dynamo_depth_torch.parallel.dist import (  # noqa: F401
    all_gather_rows,
    all_reduce_mean,
    all_reduce_sum,
    any_rank,
    barrier,
    broadcast_state,
    check_replicated,
    init_distributed,
    is_main_process,
    local_rank,
    rank,
    spawn_ranks,
    state_fingerprint,
    world_size,
)

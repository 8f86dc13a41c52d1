from action_segmentation_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    combine_rows,
    make_mesh,
    pad_batch_for_mesh,
    reduce_terms,
    replicate_module,
    run_ranks,
    shard_rows,
)

__all__ = [
    "Mesh",
    "all_reduce_grads",
    "combine_rows",
    "make_mesh",
    "pad_batch_for_mesh",
    "reduce_terms",
    "replicate_module",
    "run_ranks",
    "shard_rows",
]

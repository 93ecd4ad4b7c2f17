"""Multi-device parallel layer: the mesh, data- and sequence-parallel
sketching, all-pairs over the mesh, and the multi-process bring-up over
torch.distributed (the counterpart of the JAX package's parallel/, whose
`data_spec` is `data_rows` here and whose `sharded_gram_fn` and
`sharded_all_pairs_rect_fn` are not ported).  MeshSketcher is in
parallel/sketcher.py."""
from .mesh import (COL_AXIS, ROW_AXIS, data_rows, make_mesh, pad_to_multiple,
                   replicated)
from .allpairs import (mesh_all_pairs_packed, sharded_all_pairs_fn,
                       sharded_ani_fn)
from .sketch import (pack_genome_batch, sharded_sketch_compact_fn,
                     sharded_sketch_fn)
from .sequence import (sequence_parallel_sketch_compact_fn,
                       sequence_parallel_sketch_fn)
from .distributed import (global_mesh, init_distributed, local_batch_rows,
                          process_shard)

__all__ = [
    "COL_AXIS", "ROW_AXIS", "data_rows", "make_mesh", "pad_to_multiple",
    "replicated", "sharded_all_pairs_fn", "sharded_ani_fn",
    "pack_genome_batch", "sharded_sketch_fn", "sharded_sketch_compact_fn",
    "sequence_parallel_sketch_fn", "sequence_parallel_sketch_compact_fn",
    "mesh_all_pairs_packed", "global_mesh", "init_distributed",
    "local_batch_rows", "process_shard",
]

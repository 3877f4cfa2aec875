from phenaki_tpu_torch.parallel.distributed import (
    init_distributed,
    is_main_process,
    process_count,
    process_index,
)
from phenaki_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_multislice_mesh,
    param_partition_spec,
    pipeline_stage,
    place_like,
    replicate,
    shard_batch,
)
from phenaki_tpu_torch.parallel.pipeline import (
    make_pipeline_mesh,
    pipeline_stage_module,
    pipeline_transformer_apply,
)
from phenaki_tpu_torch.parallel.ring_attention import (
    ring_qk_norm_attention,
    sequence_sharded_attention,
)
from phenaki_tpu_torch.parallel.tp_inference import (
    pack_tp_params,
    tp_local_module,
    tp_state_dict,
)

__all__ = [
    "init_distributed",
    "is_main_process",
    "process_count",
    "process_index",
    "Mesh",
    "make_mesh",
    "make_multislice_mesh",
    "param_partition_spec",
    "pipeline_stage",
    "place_like",
    "replicate",
    "shard_batch",
    "make_pipeline_mesh",
    "pipeline_stage_module",
    "pipeline_transformer_apply",
    "ring_qk_norm_attention",
    "sequence_sharded_attention",
    "pack_tp_params",
    "tp_local_module",
    "tp_state_dict",
]

from signalizer_tpu_torch.parallel.mesh import (  # noqa: F401
    make_analysis_mesh,
    shard_batch,
    sharded_spectrum_step,
    global_peak_level,
)

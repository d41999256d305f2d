"""The port's distributed plane: meshes of ``torch.distributed`` ranks and
abstract meshes (:mod:`repro_torch.distributed.mesh`), placements and the
model-sharding rules (:mod:`repro_torch.distributed.sharding`), the GPipe
schedule (:mod:`repro_torch.distributed.pipeline`) and ranks spawned on one
host (:mod:`repro_torch.distributed.spawn`)."""

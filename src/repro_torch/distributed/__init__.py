"""The port's distributed plane: meshes of ``torch.distributed`` ranks
(:mod:`repro_torch.distributed.mesh`), the sketch plane's placements
(:mod:`repro_torch.distributed.sharding`) and ranks spawned on one host
(:mod:`repro_torch.distributed.spawn`)."""

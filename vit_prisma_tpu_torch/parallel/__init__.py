"""Parallelism of the PyTorch port: ``(data, model)`` device meshes, the
tensor-parallel ViT, the sharded SAE steps (``parallel/mesh.py``) and the
explicit collectives they use (``parallel/collectives.py``)."""

from vit_prisma_tpu_torch.parallel.mesh import (
    make_mesh, make_multislice_mesh, multislice_device_array,
    distributed_init, replicated, batch_sharding,
    vit_param_shardings, shard_vit_forward,
    sae_param_shardings, sae_state_shardings, shard_sae_train_step,
    shard_sae_train_multistep,
    sweep_state_shardings, sweep_batch_sharding, shard_sae_sweep_step,
    shard_sae_sweep_multistep, Placement, shard_tree, gather_tree, data_rows,
)

"""DUSt3R/MASt3R pre-training on one device (port of
instantsplat_tpu/train_dust3r): datasets and the reference's loaders,
the loss zoo, the trainer with JAX-layout checkpoints."""

from instantsplat_tpu_torch.train_dust3r.loaders import make_dataset  # noqa: F401
from instantsplat_tpu_torch.train_dust3r.losses import regr3d_conf_loss  # noqa: F401
from instantsplat_tpu_torch.train_dust3r.trainer import (  # noqa: F401
    load_pretrain_checkpoint,
    make_dp_train_step,
    save_pretrain_checkpoint,
    stack_microbatches,
    train_loop,
)

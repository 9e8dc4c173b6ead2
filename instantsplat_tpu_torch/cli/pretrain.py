"""Pre-training / fine-tuning CLI for the pointmap transformer (port of
instantsplat_tpu/cli/pretrain.py).

Builds a (possibly combined) dataset from a spec string, a loss from a
criterion name, and runs the one-device training loop
(train_dust3r/trainer.py) with auto-resume, bf16 mixed precision and
gradient accumulation:

  python -m instantsplat_tpu_torch.cli.pretrain \\
      --train_dataset "Co3d(ROOT='data/co3d', split='train', \\
          resolution=[(512, 384)], aug_crop=16, transform='color_jitter') \\
          + 10000 @ ScanNetpp(ROOT='data/scannetpp', ...)" \\
      --criterion mast3r_finetune --steps 10000 --batch_size 8 \\
      --bf16 --accum_iter 2 --output_dir out/ft

The spec uses the reference's --train_dataset arithmetic (`+` concat,
`n @` resize, `n *` repeat) over the loaders of train_dust3r/loaders.py
and PosedMultiViewDataset(...). Runs on CUDA by default; `--device cpu`
runs on the CPU. Under torchrun (WORLD_SIZE > 1; rank r on cuda:r over
NCCL, or gloo with `--device cpu`) the step is data parallel over
gcd(WORLD_SIZE, batch_size) ranks, as the JAX CLI uses gcd(devices,
batch_size) devices, and fully sharded with `--fsdp`; every rank reads
the same batches and rank 0 writes the checkpoints and the log.
Checkpoints are the JAX package's npz layout, so either package resumes
the other's `checkpoint-last.npz`.
"""

from __future__ import annotations

from argparse import ArgumentParser

CRITERIA = {
    # ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2): the DUSt3R
    # pre-training default
    "regr3d_conf": "regr3d_conf_loss",
    # + ConfMatchingLoss(MatchingLoss(InfoNCE)): the MASt3R fine-tuning
    # objective; needs n_corres > 0 datasets
    "mast3r_finetune": "mast3r_finetune_loss",
}

# the --tiny debug model (the JAX CLI's)
TINY = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=2, dec_num_heads=2,
            dpt_layer_dims=(8, 16, 24, 32), dpt_feature_dim=16,
            dpt_last_dim=8)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="pointmap model pre-training")
    parser.add_argument("--train_dataset", required=True,
                        help="dataset spec string (see module docstring)")
    parser.add_argument("--criterion", default="regr3d_conf",
                        choices=sorted(CRITERIA))
    parser.add_argument("--alpha", type=float, default=0.2,
                        help="conf-loss regularizer weight")
    parser.add_argument("--pretrained", default=None,
                        help="starting weights: an upstream .pth, or an "
                             ".npz checkpoint of either package (its "
                             "parameters only)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=8,
                        help="data-loading threads; also enables 2-deep "
                             "background batch prefetch. 0/1 = sequential "
                             "in-line loading")
    parser.add_argument("--accum_iter", type=int, default=1)
    parser.add_argument("--steps", type=int, default=10_000,
                        help="optimizer steps")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--min_lr", type=float, default=1e-6)
    parser.add_argument("--warmup_steps", type=int, default=100)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 mixed precision (the reference's --amp)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the float32 masters and both Adam "
                             "moments over the data ranks (cuts optimizer "
                             "memory by the number of devices); each step "
                             "all-gathers the parameters into static "
                             "buffers and reduce-scatters the gradients, "
                             "and on a card replays one captured CUDA "
                             "graph, as without --fsdp")
    parser.add_argument("--output_dir", default=None,
                        help="checkpoint dir; auto-resumes from "
                             "checkpoint-last.npz when present")
    parser.add_argument("--save_freq", type=int, default=500,
                        help="steps between checkpoint-last saves")
    parser.add_argument("--keep_freq", type=int, default=0,
                        help="steps between immutable checkpoint-{step} "
                             "snapshots (0 = off)")
    parser.add_argument("--test_dataset", default=None,
                        help="held-out dataset spec for the periodic "
                             "no-grad eval pass")
    parser.add_argument("--eval_freq", type=int, default=0,
                        help="steps between test passes (0 = end only)")
    parser.add_argument("--print_freq", type=int, default=20)
    parser.add_argument("--epochs", type=int, default=1,
                        help="passes over the dataset spec")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny debug model instead of ViT-L (smoke "
                             "runs; no pretrained weights needed)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import math

    import torch

    from instantsplat_tpu_torch import resolve_device
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.parallel import make_mesh, runtime
    from instantsplat_tpu_torch.train_dust3r import losses as L
    from instantsplat_tpu_torch.train_dust3r.datasets import prefetch_iter
    from instantsplat_tpu_torch.train_dust3r.loaders import make_dataset
    from instantsplat_tpu_torch.train_dust3r.trainer import (
        load_pretrain_checkpoint,
        stack_microbatches,
        train_loop,
    )

    runtime.initialize_runtime(args.device)
    dev = resolve_device(args.device)
    main_rank = runtime.is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    cfg = mast3r.MASt3RConfig(**TINY) if args.tiny else mast3r.MASt3RConfig()
    if args.pretrained and args.pretrained.endswith(".pth"):
        model = mast3r.build_trainable(args.pretrained, cfg, device=dev)
    else:
        model = mast3r.build_trainable(f"random:{args.seed}", cfg,
                                       device=dev)
        # an explicit --pretrained .npz seeds the parameters only; the
        # resume of checkpoint-last.npz is train_loop's
        if args.pretrained:
            load_pretrain_checkpoint(
                args.pretrained, dict(params=dict(model.named_parameters())))

    dataset = make_dataset(args.train_dataset)
    say(f"[pretrain] dataset: {dataset!r} ({len(dataset)} pairs)")

    # the DP step shares out the batch's leading axis: the mesh size must
    # divide the per-step batch
    world = runtime.world_size()
    n_dev = math.gcd(world, args.batch_size)
    mesh = make_mesh(n_dev) if n_dev > 1 else None
    if n_dev < world:
        say(f"[pretrain] batch_size {args.batch_size} uses {n_dev} of "
            f"{world} devices (DP shards the batch axis; pick batch_size % "
            "n_devices == 0 to use all)")
    if args.fsdp and mesh is None:
        say("[pretrain] --fsdp ignored: no device mesh "
            "(single device or batch_size 1)")
    if runtime.rank() >= n_dev:  # outside the mesh: idle, as in JAX
        return model

    def batches():
        it = dataset.batches(args.batch_size, seed=args.seed,
                             n_epochs=args.epochs,
                             num_workers=args.num_workers)
        if args.accum_iter > 1:
            def grouped(inner):
                while True:
                    group = [b for _, b in zip(range(args.accum_iter),
                                               inner)]
                    if len(group) < args.accum_iter:
                        return
                    yield stack_microbatches(group)

            it = grouped(it)
        if args.num_workers and args.num_workers > 1:
            # assemble ahead while the train step runs
            it = prefetch_iter(it, depth=2)
        yield from it

    eval_batches = None
    if args.test_dataset:
        test_ds = make_dataset(args.test_dataset)

        def eval_batches():
            return test_ds.batches(args.batch_size, seed=args.seed + 1)

    loss_fn = getattr(L, CRITERIA[args.criterion])
    model, history = train_loop(
        model, cfg, batches(), mesh=mesh, n_steps=args.steps,
        log_every=args.print_freq, output_dir=args.output_dir,
        save_every=args.save_freq,
        keep_every=args.keep_freq or None,
        eval_batches=eval_batches,
        eval_every=args.eval_freq or None,
        base_lr=args.lr, min_lr=args.min_lr,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        weight_decay=args.weight_decay, loss_fn=loss_fn, alpha=args.alpha,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        accum_iter=args.accum_iter,
        fsdp=args.fsdp and mesh is not None,
    )
    if history and main_rank:
        trains = [(s, m) for s, m in history if "loss" in m]
        evals = [(s, m) for s, m in history if "test_loss" in m]
        msg = "[pretrain] done:"
        if trains:
            msg += f" step {trains[-1][0]} loss {trains[-1][1]['loss']:.4f}"
        if evals:
            msg += f" test_loss {evals[-1][1]['test_loss']:.4f}"
        print(msg)
    return model


if __name__ == "__main__":
    main()

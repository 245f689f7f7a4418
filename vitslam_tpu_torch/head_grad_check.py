"""Head gradients of one global-mode train step through the attention
kernels (K3 with its lse, K4) against the same step on plain attention, at
several weight seeds, on one GPU:

    python3 -m vitslam_tpu_torch.head_grad_check [--seeds 0 1 2]

Per seed: flagship(temporal_attention=False) without its point head (the
training config's model), the training config's train keys, a synthetic
40-frame GT batch at bucket (20, 5), three steps of ``Trainer.fit``, then
one step's gradients on both paths with the same frame dropout and large
offset. Prints, per seed, a hash of the fitted trainable tensors (the
state the comparison is made at), the largest relative L2 difference over
the trainable tensors and the tensors that reach it. chip_smoke.py's train
phase runs the same comparison (``head_grad_errors``) at seed 0 and holds it
to 3e-2. ``--k4-share`` also makes the comparison at the same state with
K4 replaced by its plain fp32 version (K3 stays the kernel), and holds
each K4 call's dq, dk and dv against the plain version on fp32 copies of
its inputs. Needs CUDA.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import tempfile

import torch

BUCKET = (20, 5)
STEPS = 3


class OneBatch:
    """train_data for the Trainer: the same batch every step."""

    def __init__(self, batch: dict):
        self.batch = batch

    def get_loader(self, epoch):
        yield self.batch


def head_trainer(model, batch: dict, bucket, steps: int, tmp: str, **cfg_keys):
    """A Trainer of ``model`` with the training config's train keys
    (``train.config.VKITTI_TRAIN_CFG``, and ``cfg_keys`` over them) for
    ``steps`` steps over ``batch`` at one (width, overlap) bucket, logging
    under ``tmp``, no checkpoints along the way."""
    from .train import MultitaskLoss, Trainer
    from .train.config import VKITTI_TRAIN_CFG

    cfg = dict(VKITTI_TRAIN_CFG, max_steps=steps,
               logging={"log_dir": f"{tmp}/logs", "log_freq": 1},
               checkpoint={"save_dir": f"{tmp}/ckpt", "save_freq": 10 ** 9,
                           "resume_from_checkpoint": False})
    cfg.update(cfg_keys)
    return Trainer(cfg, model, MultitaskLoss(**cfg["loss"]), train_data=OneBatch(batch),
                   shape_buckets=[list(bucket)])


def _rel_l2(a, b) -> float:
    return (torch.linalg.vector_norm((a - b).float())
            / torch.linalg.vector_norm(b.float()).clamp_min(1e-30)).item()


def state_hash(trainer) -> str:
    """The first 12 hex digits of a SHA-256 over the trainable tensors."""
    h = hashlib.sha256()
    for name, t in sorted(trainer.state.trainable.items()):
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def head_grad_errors(trainer, batch: dict, bucket) -> dict:
    """One step's gradients of the trainable tensors at the trainer's state,
    through the kernels and on plain attention, with the same frame dropout
    and large offset: ``errs`` (tensor name -> relative L2 difference, for
    every tensor whose plain gradient is nonzero, largest first), the K4
    calls each path made (``k4_calls``: kernel path, plain path) and the
    two objectives."""
    from .train import loss_and_grads

    k4 = importlib.import_module("vitslam_tpu_torch.ops.flash_attention").flash_attention_backward
    width, overlap = bucket
    chunks, merged = trainer._prepare_chunks(batch, width, overlap)
    state = trainer.state
    args = (trainer.model, trainer.loss, state.trainable, chunks, merged, state.step, overlap,
            trainer.gt_alignment_type)
    calls = []
    outs = []
    for plain in (False, True):
        before = k4.launches
        losses, grads = loss_and_grads(*args, generator=torch.Generator().manual_seed(11),
                                       plain_attention=plain)
        if grads and next(iter(grads.values())).is_cuda:
            torch.cuda.synchronize()
        calls.append(k4.launches - before)
        outs.append((losses["objective"].item(), grads))
    (k_obj, kernel), (p_obj, plain) = outs
    errs = {n: _rel_l2(kernel[n], plain[n]) for n in kernel if plain[n].abs().max() > 0}
    if not errs:
        raise RuntimeError("no trainable tensor has a nonzero gradient")
    errs = dict(sorted(errs.items(), key=lambda kv: -kv[1]))
    return dict(errs=errs, k4_calls=tuple(calls), objective=(k_obj, p_obj))


def k4_share(trainer, batch: dict, bucket) -> dict:
    """At the trainer's state: the largest relative L2 difference of
    ``head_grad_errors`` with the kernels, and with K4 replaced by its plain
    version (fp32 inside, bf16 out; K3 stays the kernel); and for each K4
    call of the kernel path, the relative L2 difference of its dq, dk and
    dv from the plain version on fp32 copies of the same inputs."""
    fa = importlib.import_module("vitslam_tpu_torch.ops.flash_attention")
    k4 = fa.flash_attention_backward
    calls = []

    def held(q, k, v, out, lse, dout):
        got = k4(q, k, v, out, lse, dout)
        ref = fa.flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                                lse, dout.float())
        calls.append(dict(shape=tuple(q.shape), **{n: _rel_l2(g, r) for n, g, r in
                                                    zip(("dq", "dk", "dv"), got, ref)}))
        return got

    out = {}
    # the autograd Function looks K4 up in its module at each backward
    for label, bwd in (("kernels", held), ("k4_plain", fa.flash_attention_backward_plain)):
        bwd.launches = 0  # K4 counts its calls under its module name
        fa.flash_attention_backward = bwd
        try:
            out[label] = next(iter(head_grad_errors(trainer, batch, bucket)["errs"].items()))
        finally:
            fa.flash_attention_backward = k4
    out["k4_calls_vs_fp32"] = calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--k4-share", action="store_true",
                    help="also the comparison with K4's plain version in its place, "
                         "and each K4 call against fp32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("head_grad_check needs a CUDA GPU")
    from .models import flagship
    from .utils import make_synthetic_batch

    batch = make_synthetic_batch(B=1, N=40, H=154, W=518, seed=3)
    for seed in args.seeds:
        model = flagship(device="cuda", seed=seed, enable_point=False, temporal_attention=False)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = head_trainer(model, batch, BUCKET, STEPS, tmp)
            trainer.fit()
        res = head_grad_errors(trainer, batch, BUCKET)
        worst = list(res["errs"].items())[:3]
        line = dict(seed=seed, state=state_hash(trainer), tensors=len(res["errs"]),
                    max_rel_l2=worst[0][1], worst=worst, k4_calls=res["k4_calls"])
        if args.k4_share:
            line["k4_share"] = k4_share(trainer, batch, BUCKET)
        print(json.dumps(line), flush=True)
        del model, trainer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Convert a facebook/VGGT-1B (or reference FeatureAlignedVGGT) torch
checkpoint into a port checkpoint (port of scripts/convert_vggt_checkpoint.py),
with torch and numpy alone: no JAX, flax or safetensors package.

    python -m vitslam_tpu_torch.convert_vggt_checkpoint \\
        --torch-ckpt model.safetensors|model.pt --out vggt1b_port.ckpt \\
        [--model feature_aligned|point_aligned|pose_aligned] [--strict] \\
        [--no-track] [--seed 0]

The model is the flagship preset ``--model`` names (``models/presets.py``:
``flagship``, ``flagship_point_aligned``, ``flagship_pose_aligned``), built
on the ``meta`` device: shapes alone, no memory. The source is read through
a memory map (``io/from_vggt.py::load_vggt_state_dict``) and mapped onto the
port's parameter names (``map_vggt``), so the peak host memory stays near
one copy of the weights; nothing runs on a GPU. The preset reads
``VITSLAM_MLP_TAIL`` and ``VITSLAM_INT8`` as everywhere, and neither changes
anything here: the fused tails and the int8 projections run on the same
parameters, so the file is the same under any setting.

* Without ``--no-track`` the model has the TrackHead: VGGT-1B ships
  trained track weights, and conversion keeps them. A flagship without
  the head ignores its ``core.track_head.*`` names when it loads the file.
* Parameters the checkpoint lacks (VGGT-1B has no AlignmentHead) keep the
  port's seeded init (``seeded_missing``): only they are made on the CPU,
  drawn from one CPU generator seeded ``--seed`` in the order a
  whole-model init takes them. The AlignmentHead is the first module that
  order draws, so its values are those of the preset built on the CPU
  with the same seed. They are the port's values and not bit-equal to the
  JAX script's ``PRNGKey(0)`` init.
* ``--strict`` raises when a parameter is left unfilled (a pure VGGT-1B
  file always leaves the AlignmentHead), naming it; a shape that differs
  raises whether strict or not.

The source keys the rules drop (DINOv2's ``mask_token``, refinenet4's
``resConfUnit1``, heads the model does not build), the keys no rule names
and the parameters left at init are listed. The output is the whole
model's parameters by name, written by ``io/checkpoint.py::save_checkpoint``:
``load_model_params(out, model)``, strict and with no fallback, fills every
parameter, which is what ``checkpoint.from_pretrained`` does. The last
line printed is a JSON summary: counts, seconds, the resident set when
the conversion starts (the interpreter with torch imported) and the
largest resident set a thread read every 10 ms while it ran (a sample:
memory taken and given back between two reads is not seen).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

import torch

from .io.checkpoint import save_checkpoint
from .io.from_vggt import load_vggt_state_dict, map_vggt
from .models.presets import flagship, flagship_point_aligned, flagship_pose_aligned

PRESETS = {"feature_aligned": flagship, "point_aligned": flagship_point_aligned,
           "pose_aligned": flagship_pose_aligned}


def seeded_missing(model: torch.nn.Module, names: list, seed: int) -> dict:
    """name -> value of the parameters ``names`` of a ``meta`` model, drawn
    by the modules' ``init_params`` from one CPU generator seeded ``seed``,
    children first and the last registered first, as ``init_weights``
    takes a whole model. Only the parameters ``names`` are made on the CPU;
    every module holding one, or with one below it, runs its init, in
    which the parameters left on ``meta`` draw nothing. So a parent's init
    that overrides a child's (the tracker's flow head) still reaches an
    unfilled child, and a missing track head costs the track head alone."""
    unfilled = set(names)
    holders = {""} if unfilled else set()
    for n in unfilled:
        parts = n.split(".")[:-1]
        holders.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for prefix, module in reversed(list(model.named_modules())):
            if prefix not in holders:
                continue
            for leaf, p in list(module.named_parameters(recurse=False)):
                if (f"{prefix}.{leaf}" if prefix else leaf) in unfilled:
                    module._parameters[leaf] = torch.nn.Parameter(
                        torch.empty_like(p, device="cpu"), requires_grad=p.requires_grad)
            if hasattr(module, "init_params"):
                module.init_params(g)
    params = dict(model.named_parameters())
    return {n: params[n].detach() for n in names}


def status_bytes(field: str):
    """A size field of /proc/self/status (``VmRSS``) in bytes; None where
    the system does not report it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


@contextlib.contextmanager
def sampled_rss(interval: float = 0.01):
    """A one-item list: the largest ``VmRSS`` a thread reads every
    ``interval`` s while the block runs (None where the system does not
    report it)."""
    peak, stop = [status_bytes("VmRSS")], threading.Event()

    def sample():
        while not stop.wait(interval):
            r = status_bytes("VmRSS")
            if r is not None:
                peak[0] = max(peak[0] or 0, r)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield peak
    finally:
        stop.set()
        thread.join()


def _listed(title: str, keys: list) -> None:
    if keys:
        print(f"{title} ({len(keys)}), e.g.:")
        for k in keys[:20]:
            print("  ", k)


def convert(torch_ckpt: str, out: str, model: str = "feature_aligned", strict: bool = False,
            track: bool = True, seed: int = 0, overrides: dict | None = None) -> dict:
    """Convert ``torch_ckpt`` into the port checkpoint ``out`` (module
    docstring); returns the summary ``main`` prints last (there with the
    lengths of its lists). ``overrides`` are preset keywords (a small
    model in tests)."""
    t0 = time.perf_counter()
    with sampled_rss() as peak:
        rss_start = peak[0]
        net = PRESETS[model](device="meta", enable_track=track, **(overrides or {}))
        params = dict(net.named_parameters())
        sd = load_vggt_state_dict(torch_ckpt)
        mapping = map_vggt(sd, params, strict=strict)
        _listed("source keys dropped (dead weights, heads this model does not build)",
                mapping.dropped)
        _listed("unmatched source keys", mapping.unmatched)
        values = dict(mapping.values)
        values.update(seeded_missing(net, mapping.unfilled, seed))
        _listed(f"parameters left at the port's init (seed {seed})", mapping.unfilled)
        save_checkpoint(out, {name: values[name] for name in params})
    return dict(out=out, bytes=os.path.getsize(out), params=len(params),
                source_keys=len(sd), dropped=mapping.dropped, unmatched=mapping.unmatched,
                left_at_init=mapping.unfilled, seconds=time.perf_counter() - t0,
                rss_start_bytes=rss_start, rss_sampled_max_bytes=peak[0])


def main(argv=None, overrides: dict | None = None) -> int:
    """The command line; ``overrides`` are ``convert``'s preset keywords,
    given by a caller (a test's small model), never by a flag."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="feature_aligned", choices=sorted(PRESETS))
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--no-track", action="store_true",
                    help="skip the track_head weights (smaller output)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters the checkpoint lacks")
    args = ap.parse_args(argv)
    summary = convert(args.torch_ckpt, args.out, args.model, args.strict, not args.no_track,
                      args.seed, overrides)
    print(f"wrote {args.out}")
    print(json.dumps({k: len(v) if isinstance(v, list) else v for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

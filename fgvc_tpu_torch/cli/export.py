#!/usr/bin/env python
"""Export CLI of the port (fgvc_tpu/cli/export.py).

The default format, pt2, writes the per-frame serving step (core/export.py)
as a torch.export program: one ``.pt2`` file with the weights embedded,
which a serving process loads with ``core.export.load_exported`` and calls
without the model's Python code.  The program holds the top-k attention
kernel (K2) as the registered operator ``fgvc_tpu_torch::topk_attention``.

    python -m fgvc_tpu_torch.cli.export --out step.pt2 --check
    python -m fgvc_tpu_torch.cli.export --checkpoint res18_d1.pth \
        --input-size 256 256 --out step.pt2 [--precision high] [--device cpu]

``--device`` takes the place of fgvc_tpu's ``--platforms``: a torch.export
program keeps its weights on the device it was exported on, so the artifact
runs there (the CUDA card by default).  ``--attention-impl`` 'pallas' (the
default here) exports the kernel as the operator; 'tiled' (fgvc_tpu's
default), 'dense' and 'c2f' export their plain PyTorch.

``--format torch`` writes the encoder as a reference-compatible ``.pth``
instead ({'state_dict': ...}, mmcv names under ``backbone.``), from a
training checkpoint of fgvc_tpu_torch.cli.train (a step_N directory, or a
latest/best pointer) or from a ``.pth`` to re-normalise:

    python -m fgvc_tpu_torch.cli.export --format torch \
        --checkpoint runs/mixed/best --out student.pth
"""

import argparse
import dataclasses
import sys

CHECK_TOL = 1e-5  # --check: reloaded program against the step, max |diff|


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="fgvc_tpu_torch export")
    parser.add_argument("--out", required=True, help="artifact path")
    parser.add_argument("--checkpoint", default=None,
                        help="reference .pth, or a training checkpoint (step_N "
                             "directory, WORK_DIR/latest or /best); seeded random "
                             "weights if omitted (pt2 only)")
    parser.add_argument("--input-size", type=int, nargs=2, default=None, metavar=("H", "W"))
    parser.add_argument("--value-dim", type=int, default=8,
                        help="propagated channels (points per group / classes)")
    parser.add_argument("--attention-impl", default="pallas",
                        choices=["tiled", "dense", "pallas", "c2f"],
                        help="pallas: the top-k attention kernel as the operator; "
                             "tiled, dense, c2f: their plain PyTorch")
    parser.add_argument("--precision", default=None, choices=["highest", "high", "default"],
                        help="the attention's matmul precision (default: highest)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the device the program is exported on, and runs on")
    parser.add_argument("--check", action="store_true",
                        help="reload the artifact and compare it with the step")
    parser.add_argument("--format", default="pt2", choices=["pt2", "torch"],
                        help="torch = reference-compatible encoder .pth")
    return parser


def read_state(checkpoint: str):
    """A ResNet-18-d1 state dict in the port's names: a reference .pth, or
    the student of a training checkpoint."""
    from fgvc_tpu_torch.core.checkpoint import student_state_dict
    from fgvc_tpu_torch.models.weights import load_reference_pth

    if checkpoint.endswith(".pth"):
        return load_reference_pth(checkpoint)
    return student_state_dict(checkpoint)


def export_torch(args) -> None:
    """The encoder's weights -> a reference-compatible torch .pth."""
    import torch

    from fgvc_tpu_torch.models.weights import export_reference_state_dict

    if not args.checkpoint:
        raise SystemExit("--format torch needs --checkpoint (a training checkpoint "
                         "directory, a work_dir best/latest pointer, or a .pth to "
                         "re-normalise)")
    state = export_reference_state_dict(read_state(args.checkpoint))
    torch.save({"state_dict": state}, args.out)
    print(f"wrote reference-compatible checkpoint: {args.out} "
          f"({len(state)} tensors, mmcv naming, 'backbone.' prefix)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.format == "torch":
        export_torch(args)
        return

    import torch

    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.core.export import export_flagship, load_exported, save_exported

    cfg = dataclasses.replace(TestConfig(), attention_impl=args.attention_impl)
    if args.precision:
        cfg = dataclasses.replace(cfg, matmul_precision=args.precision)
    state = read_state(args.checkpoint) if args.checkpoint else None
    exported, step, example_args = export_flagship(
        cfg, state, input_size=args.input_size, value_dim=args.value_dim, device=args.device,
    )
    size = save_exported(exported, args.out)
    print(f"exported {args.out}: {size / 1e6:.2f} MB, device={example_args[0].device}, "
          f"in={[f'{tuple(a.shape)} {a.dtype}' for a in example_args]}")
    if args.check:
        restored = load_exported(args.out)
        with torch.no_grad():
            got = restored.module()(*example_args)
            want = step(*example_args)
        err = float((got - want).abs().max())
        print(f"round-trip max|Δ| = {err:.3e}")
        if not err < CHECK_TOL:
            raise SystemExit(f"check failed: max|Δ| {err} >= {CHECK_TOL}")
        print("check ok")


if __name__ == "__main__":
    sys.exit(main())

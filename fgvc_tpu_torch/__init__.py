"""PyTorch/CUDA port of fgvc_tpu for NVIDIA Hopper.

The package stands beside the JAX package ``fgvc_tpu`` (the reference it is
tested against) and imports nothing of it.  Evaluation:
``python -m fgvc_tpu_torch.cli.test --task davis|vos``; training:
``python -m fgvc_tpu_torch.cli.train --synthetic``.
"""

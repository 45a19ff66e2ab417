"""The differentiable volume scene (``libre_tpu.models``)."""

from libre_tpu_torch.models.volume_scene import VolumeScene

__all__ = ["VolumeScene"]

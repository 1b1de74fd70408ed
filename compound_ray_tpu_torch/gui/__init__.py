"""The interactive viewer (gui/viewer.py) on the port's EyeRenderer."""

from compound_ray_tpu_torch.gui.viewer import FlyController, Viewer

__all__ = ["FlyController", "Viewer"]

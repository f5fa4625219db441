from marie_tpu_torch.overlay.overlay import OverlayProcessor

__all__ = ["OverlayProcessor"]

from .environment import kernel_build_dir, resolve_device

__all__ = ["kernel_build_dir", "resolve_device"]

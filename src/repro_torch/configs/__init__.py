"""Architecture registry of the port and reduced smoke twins."""

from repro_torch.configs.registry import ARCHS, get_arch, smoke_config  # noqa: F401

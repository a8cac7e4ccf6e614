from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec, get_config, list_configs  # noqa: F401

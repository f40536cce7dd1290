from .dit import DIT_CONFIGS, DiT, DiTConfig, create_model  # noqa: F401

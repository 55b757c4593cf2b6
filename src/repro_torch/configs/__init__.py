"""Model configurations; mirrors ``repro/configs``."""

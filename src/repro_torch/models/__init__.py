"""Models; mirrors ``repro/models`` (the mamba path so far)."""

"""Architecture configurations (pure data; the counterpart of
``repro.configs``), resolved by name through ``registry.get``."""

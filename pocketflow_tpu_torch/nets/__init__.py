"""Network definitions and model helpers."""

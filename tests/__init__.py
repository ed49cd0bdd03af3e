"""Test package: test modules import shared helpers as ``tests.<module>``."""

"""Test-only references that need nothing but numpy."""

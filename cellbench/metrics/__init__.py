"""Found by name; see cellbench/lookup.py."""

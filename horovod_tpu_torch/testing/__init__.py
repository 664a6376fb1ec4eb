"""Test harnesses that ship with the port: the seeded fault injector
(testing/faults.py)."""

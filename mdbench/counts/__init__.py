"""The yardstick's counts: the work a step needs, from the system's own sizes."""

"""The multi-round driver."""

"""Entry points of the port (``serve``: the static serving launcher)."""

"""The system under test: one module per kind of configuration, each
driving the port's own entry points (``config["entry"]`` names it)."""

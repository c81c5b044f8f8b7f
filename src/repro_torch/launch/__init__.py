"""Launch layer of the port: command-line entry points."""

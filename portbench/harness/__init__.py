"""The harness: finds a cell's configuration, traffic and metrics by name,
drives the program's timed path, reads the trace and checks the outputs."""

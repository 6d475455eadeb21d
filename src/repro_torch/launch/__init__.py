"""Step functions and the server (port of ``repro/launch``)."""

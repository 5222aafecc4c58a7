"""Launchers of the port (counterpart of ``repro.launch``)."""

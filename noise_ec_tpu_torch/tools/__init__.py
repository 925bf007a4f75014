"""Command-line tools of the port: ``hwcheck``, the hardware kernel sweep."""

"""The REST service on the standard library's HTTP server."""

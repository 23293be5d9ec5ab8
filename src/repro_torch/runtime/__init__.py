"""The static-batch serving loop (``serve_loop``)."""

"""One reader a per-layer metric, ``<metric name>.py``, each with
``read(ctx) -> number or None``; ``common`` holds what they share."""

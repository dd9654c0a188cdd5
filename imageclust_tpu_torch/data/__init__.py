"""Host-side ingest: decode + resize to the embedder's input size."""

"""Entry points: inference engine, checkpoint restore, HTTP model server."""

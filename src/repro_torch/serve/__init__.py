"""Serving: ``api.build`` turns a verified program into a serving engine."""

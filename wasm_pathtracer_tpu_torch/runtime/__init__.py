"""Session API and CLI."""

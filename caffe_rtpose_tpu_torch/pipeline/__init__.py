"""The realtime pipeline: frame sources, queues, the threaded runner."""

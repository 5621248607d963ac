"""Service runtime helpers: heartbeats and straggler detection."""

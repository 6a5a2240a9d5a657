"""Host-side problem models: vertices and segment-time heuristics."""

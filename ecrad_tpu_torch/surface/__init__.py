"""The surface scheme of the port: only the tiled-surface detection so
far (ROADMAP.md Queue A, slice 8)."""

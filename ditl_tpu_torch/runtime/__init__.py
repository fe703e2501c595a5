"""Process-group runtime: ``distributed.is_coordinator``. Meshes, elastic
recovery and pod launch are not ported yet (ROADMAP.md)."""

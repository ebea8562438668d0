"""Data-parallel training across processes: process-group set-up, the mesh
checks and the collectives that give every BN SyncBN semantics."""

"""Core data structures of the port: level schedules, the bulk pyramid
build and the paper's dataset generators."""

"""Core: objectives, schedules, plain SDCA routines and the engine."""

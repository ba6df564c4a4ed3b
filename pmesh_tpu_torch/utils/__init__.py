from .timers import Timer, Timers, trace  # noqa: F401

from . import adamw, schedules

from . import adamw, grad_accum, schedules

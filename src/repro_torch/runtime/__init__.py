# ``serving`` is imported explicitly: it pulls in the model and executor
# stack, while ``wire`` is imported by the host planner (core.cost_model)
from . import compression, wire

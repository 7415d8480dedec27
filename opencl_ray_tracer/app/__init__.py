from opencl_ray_tracer.app.state import State, StateManager
from opencl_ray_tracer.app.input import ButtonState, InputManager
from opencl_ray_tracer.app.main_state import MainState
from opencl_ray_tracer.app.frame import run_interactive, run_scripted

__all__ = [
    "State",
    "StateManager",
    "ButtonState",
    "InputManager",
    "MainState",
    "run_interactive",
    "run_scripted",
]

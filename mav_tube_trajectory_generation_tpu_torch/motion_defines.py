"""Derivative-order constants and string conversions.

Reference: the C++ project's motion_defines.h:28-41 and
motion_defines.cpp:25-75.  The port's own copy of the JAX package's module.
"""

POSITION = 0
VELOCITY = 1
ACCELERATION = 2
JERK = 3
SNAP = 4

ORIENTATION = 0
ANGULAR_VELOCITY = 1
ANGULAR_ACCELERATION = 2

INVALID = -1

_POSITION_NAMES = {
    POSITION: "position",
    VELOCITY: "velocity",
    ACCELERATION: "acceleration",
    JERK: "jerk",
    SNAP: "snap",
}
_ORIENTATION_NAMES = {
    ORIENTATION: "orientation",
    ANGULAR_VELOCITY: "angular_velocity",
    ANGULAR_ACCELERATION: "angular_acceleration",
}


def position_derivative_to_string(derivative: int) -> str:
    return _POSITION_NAMES.get(derivative, "invalid")


def position_derivative_to_int(name: str) -> int:
    for k, v in _POSITION_NAMES.items():
        if v == name:
            return k
    return INVALID


def orientation_derivative_to_string(derivative: int) -> str:
    return _ORIENTATION_NAMES.get(derivative, "invalid")


def orientation_derivative_to_int(name: str) -> int:
    for k, v in _ORIENTATION_NAMES.items():
        if v == name:
            return k
    return INVALID

"""Simulation bridges: CARLA and SODA.Sim (simulation/* of the JAX package)."""
from .carla_bridge import CarlaBridge, StatePublisherBridge
from .carla_publishers import (
    CarlaCameraPublisher, CarlaOdomPublisher, CarlaWaypointsPublisher,
    CarlaRoadShapePublisher, CarlaControlSubscriber)
from .soda_sim import ImageToGStreamerBridge

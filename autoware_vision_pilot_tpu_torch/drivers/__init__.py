from .can_interface import CanInterface, CanVehicleState
from .camera import open_camera, list_cameras, open_video

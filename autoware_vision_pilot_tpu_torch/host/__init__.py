from .shm import SharedStatePublisher, SharedStateReader, VisionPilotStateStruct

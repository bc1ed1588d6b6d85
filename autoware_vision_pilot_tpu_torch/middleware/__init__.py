from .backend import InferenceBackend, TorchInferenceBackend, backend_from_params
from .transport import Transport, InProcTransport, make_transport
from .nodes import (RunModelNode, RunAutoSpeedNode, VideoPublisherNode,
                    MasksVisualizationNode, DepthVisualizationNode,
                    PathFinderNode, SteeringControllerNode,
                    LongitudinalControllerNode, launch_pipeline)

from .efficientnet import EfficientNetB0Features
from .scene_seg import SceneSegNetwork
from .scene_3d import Scene3DNetwork
from .domain_seg import DomainSegNetwork
from .ego_lanes import EgoLanesNetwork

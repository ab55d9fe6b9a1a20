from .adaptive import AdaptiveParameterManager

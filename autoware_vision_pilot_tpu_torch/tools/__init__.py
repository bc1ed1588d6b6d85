"""Command-line tools of the port: the export of the native-app bundles and
of every model family, the accuracy tools (the synthetic dataset, the
SceneSeg, AutoSteer-temporal and AutoSpeed training demos, the QAT-to-int8
closure, checkpoint validation, the AutoSteer debug harness) and the bench
tools (the application loop, the train step, the fleet, the model zoo and
the main path's per-stage profile)."""

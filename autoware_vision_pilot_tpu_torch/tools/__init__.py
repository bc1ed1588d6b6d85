"""Command-line tools of the port: the export of the native-app bundles and
of every model family."""

"""Training helpers of the port. Only what export/eval_lite.py needs is
here yet; training itself is ROADMAP Queue 1 item 6."""

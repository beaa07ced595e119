"""Seconds from process start to the window's start: imports, the kernel build (first
run in a checkout only), the cell's set-up and warm-up (host clock)."""


def read(context):
    return context["setup_s"]

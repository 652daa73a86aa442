"""Run-completion notification, as ``ndcn_tpu/report/notify.py`` without
its pluggable transport: a print (the reference's SMS pusher is out of
scope)."""


def send_notification(message: str) -> None:
    print(f"[notify] {message}", flush=True)

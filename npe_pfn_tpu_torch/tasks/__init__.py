from .registry import Task, get_task, list_tasks  # noqa: F401

"""launches: the port's kernel launches a call (``build.launches`` summed over the untraced
window, over its calls): what the kernel wrappers ran."""


def read(record):
    if not record['calls']:
        return None
    return sum(record['launches'].values()) / record['calls']

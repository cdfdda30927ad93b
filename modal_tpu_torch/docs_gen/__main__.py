"""`python -m modal_tpu_torch.docs_gen [output_dir]`: generate the API and
CLI docs (default output docs/reference_torch)."""

import sys

from . import gen_cli_docs, gen_reference_docs


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "docs/reference_torch"
    written = gen_reference_docs(out_dir)
    cli_path = gen_cli_docs(out_dir)
    print(f"wrote {len(written)} reference pages + {cli_path}")


if __name__ == "__main__":
    main()
